"""Text-to-image sampling over captions, optionally CLIP re-ranked, to the
files the reference's evaluation reads.

    python -m hqtransformer_tpu_torch.cli.sampling_hqmodel_txt2img \
        -r <out dir> -c <config.yaml> -m <reference .ckpt> \
        --captions <file, one caption a line> [--clip-rerank N \
        --clip-weights <official CLIP state dict>] [--device cpu]

The port's counterpart of the JAX package's root
`sampling_hqmodel_txt2img.py`, with its arguments. Captions come from
`--captions` or from the tab-separated `<data-root>/val_list.txt`
(second column). Each batch of `--batch-size` captions is tokenized by the
config's caption tokenizer and sampled once a caption into
`samples_(<batch + 1>_<batch size>).pkl` (f32 [B, 3, H, W] in [0, 1]),
and its captions go to `captions_(<batch + 1>_<batch size>).txt`. With
`--clip-rerank N`, every caption is sampled N times and its candidates
kept best first by CLIP (`evaluation/clip_rerank.py`, its text through
CLIP's own tokenizer): the pickle holds [B, N, 3, H, W] and
`clip_scores_(...).npz` the sorted scores (`scores`, [B, N]).
`--clip-weights` is an official CLIP ViT-B/32 state dict (`torch.save`
of a dict or a module).

Differences from the JAX script: it runs on the card unless `--device
cpu` asks for the CPU; its draws come from one `torch.Generator` seeded
by `--seed` (the JAX key stream cannot be reproduced); `-m` takes the
reference's PyTorch checkpoints only.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from ..data.tokenizers import create_tokenizer
from ..evaluation.clip_rerank import (VIT_B32, CLIP, clip_rerank,
                                      official_state)
from ..sampling.engine import SamplingParams
from .common import add_model_args, load_model, save_pickle

# The re-ranking CLIP's shape: ViT-B/32, as the JAX script builds it.
CLIP_CONFIG = VIT_B32


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    add_model_args(ap)
    ap.add_argument('-c', '--config', type=str, required=True)
    ap.add_argument('--data-root', type=str, default=None,
                    help='CC3M root containing val_list.txt')
    ap.add_argument('--captions', type=str, default=None,
                    help='plain text file, one caption per line')
    ap.add_argument('--top-k', type=int, default=8192)
    ap.add_argument('--top-p', type=float, default=1.0)
    ap.add_argument('--temperature', type=float, default=0.9)
    ap.add_argument('--temperature-decay', type=float, default=1.0)
    ap.add_argument('--batch-size', type=int, default=16)
    ap.add_argument('--code-level', type=int, default=2)
    ap.add_argument('--max-batches', type=int, default=None)
    ap.add_argument('--vocab-dir', type=str, default=None)
    ap.add_argument('--clip-rerank', type=int, default=0, metavar='N',
                    help='generate N candidates per caption and keep them '
                         'CLIP-ranked best first (requires --clip-weights)')
    ap.add_argument('--clip-weights', type=str, default=None,
                    help='official CLIP ViT-B/32 state dict (.pt)')
    return ap.parse_args(argv)


def load_captions(args):
    if args.captions:
        with open(args.captions) as fp:
            return [ln.strip() for ln in fp if ln.strip()]
    if not args.data_root:
        raise SystemExit('pass --captions or --data-root')
    caps = []
    with open(os.path.join(args.data_root, 'val_list.txt')) as fp:
        for ln in fp:
            parts = ln.rstrip('\n').split('\t')
            if len(parts) >= 2:
                caps.append(parts[1])
    return caps


def load_clip(path: str, device: torch.device) -> CLIP:
    """CLIP (`CLIP_CONFIG`) with the official state dict at `path` (a
    trusted file: it is unpickled), strictly loaded, f32, on `device`."""
    state = official_state(torch.load(path, map_location='cpu',
                                      weights_only=False))
    with torch.device('meta'):
        model = CLIP(CLIP_CONFIG)
    model.load_state_dict(state, strict=True, assign=True)
    return model.to(device).eval()


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.clip_rerank and not args.clip_weights:
        raise SystemExit('--clip-rerank requires --clip-weights')
    os.makedirs(args.result_path, exist_ok=True)
    model, weights = load_model(args, args.config)
    cfg = model.config
    tokenizer = create_tokenizer(cfg.dataset.tokenizer_type,
                                 vocab_dir=args.vocab_dir)
    ctx_len = cfg.stage2.hparams.ctx_len_txt
    captions = load_captions(args)

    temps = [args.temperature * args.temperature_decay ** i
             for i in range(args.code_level)]
    top_p = args.top_p if args.top_p and args.top_p < 1.0 else None
    sampler = model.make_pixel_sampler(params=SamplingParams(
        top_k_top=args.top_k, top_p_top=top_p, top_k_bot=args.top_k,
        top_p_bot=top_p, temperature_top=temps[0],
        temperature_bot=temps[-1]))
    generator = torch.Generator(device=model.device).manual_seed(args.seed)
    bs = args.batch_size
    n_batches = len(captions) // bs
    if args.max_batches:
        n_batches = min(n_batches, args.max_batches)

    if args.clip_rerank:
        clip = load_clip(args.clip_weights, model.device)
        # CLIP's text tower reads its own BPE, not the caption tokenizer
        clip_tokenizer = create_tokenizer('clip', vocab_dir=args.vocab_dir)
        print('CLIP weights loaded for re-ranking')

    def ids(texts, n):
        return torch.tensor([tokenizer.encode_padded(t, n) for t in texts],
                            dtype=torch.long, device=model.device)

    for bi in range(n_batches):
        batch = captions[bi * bs:(bi + 1) * bs]
        name = f'({bi + 1}_{bs})'
        if args.clip_rerank:
            n = args.clip_rerank
            ranked_all, scores_all = [], []
            for cap in batch:
                pixels, _ = sampler(weights, generator,
                                    ids([cap], ctx_len).repeat(n, 1))
                clip_ids = torch.tensor(
                    [clip_tokenizer.encode_padded(cap, 77)])
                order, scores = clip_rerank(clip, pixels, clip_ids)
                ranked_all.append(pixels.float()[order.to(pixels.device)]
                                  .cpu().numpy())
                scores_all.append(scores.cpu().numpy())
            arr = np.stack(ranked_all).transpose(0, 1, 4, 2, 3)
            np.savez(os.path.join(args.result_path,
                                  f'clip_scores_{name}.npz'),
                     scores=np.stack(scores_all))
        else:
            pixels, _ = sampler(weights, generator, ids(batch, ctx_len))
            arr = pixels.float().cpu().numpy().transpose(0, 3, 1, 2)
        save_pickle(os.path.join(args.result_path, f'samples_{name}.pkl'),
                    arr)
        with open(os.path.join(args.result_path, f'captions_{name}.txt'),
                  'w') as fp:
            fp.write('\n'.join(batch))
        print(f'batch {bi + 1}/{n_batches} written', flush=True)
    print(f'done: {n_batches * bs} samples -> {args.result_path}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
