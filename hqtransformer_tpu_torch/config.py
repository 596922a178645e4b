"""Typed configuration schema for the PyTorch port, reading the same YAML
files as `hqtransformer_tpu/config.py`.

The port keeps its own copy of the schema so that it imports nothing of the
JAX package: plain dataclasses overlaid with PyYAML, and the parsed
descriptors (`parse_model_type`, `parse_embedding_type`, `parse_resample`)
that replace the reference's stringly-typed runtime dispatch.
"""

from __future__ import annotations

import dataclasses
import math
import os
import re
from dataclasses import dataclass, field
from typing import Any, List, Optional

import yaml


# ---------------------------------------------------------------------------
# Schema dataclasses
# ---------------------------------------------------------------------------

@dataclass
class DataConfig:
    dataset: Optional[str] = None
    image_resolution: int = 256
    tokenizer_type: str = 'bpe16k_huggingface'
    context_length: int = 64
    transforms: str = 'dalle-vqvae'
    bpe_pdrop: Optional[float] = 0.1


@dataclass
class Stage1Hparams:
    """Conv backbone hyper-parameters."""
    double_z: bool = False
    z_channels: int = 256
    resolution: int = 256
    in_channels: int = 3
    out_ch: int = 3
    ch: int = 128
    ch_mult: List[int] = field(default_factory=lambda: [1, 1, 2, 2, 4])
    num_res_blocks: int = 2
    attn_resolutions: List[int] = field(default_factory=lambda: [16])
    pdrop: float = 0.0
    use_init_downsample: bool = False
    use_mid_block: bool = True
    use_attn: bool = True


@dataclass
class Stage1HparamsDisc:
    """GAN/LPIPS loss hyper-parameters (read so combined YAMLs parse)."""
    disc_conditional: bool = False
    disc_in_channels: int = 3
    disc_start: int = 0
    disc_weight: float = 0.75
    disc_num_layers: int = 2
    codebook_weight: float = 1.0
    norm_type: str = 'bn'
    residual_l1_weight: Optional[float] = None
    use_recon_top: bool = True
    use_perceptual_top: bool = False
    use_adversarial_top: bool = False


@dataclass
class VQGAN2Hparams:
    """Aux hyper-parameters for multi-level stage-1 models."""
    upsample: Optional[str] = None
    shared_codebook: Optional[bool] = None
    bottom_start: Optional[int] = 100000000000
    decoding_type: str = 'concat'
    restart_unused_codes: Optional[bool] = None
    code_levels: Optional[int] = None


@dataclass
class Stage1Config:
    type: str = 'vqgan'
    embed_dim: int = 256
    n_embed: int = 16384
    n_embed_levels: List[int] = field(default_factory=lambda: [8192, 8192, 8192])
    ema_update: bool = False
    hparams: Stage1Hparams = field(default_factory=Stage1Hparams)
    hparams_disc: Optional[Stage1HparamsDisc] = None
    hparams_aux: Optional[VQGAN2Hparams] = None


@dataclass
class Stage2Hparams:
    """Transformer hyper-parameters."""
    embed_dim: int = 1536
    n_layers: int = 42
    n_heads: int = 24
    n_dense_layers: int = 42
    ctx_len: Optional[int] = None
    ctx_len_img: int = 256
    ctx_len_txt: int = 64
    embd_pdrop: float = 0.0
    resid_pdrop: float = 0.0
    attn_pdrop: float = 0.0
    mlp_bias: bool = True
    attn_bias: bool = True
    gelu_use_approx: bool = False
    use_head_txt: bool = True
    n_classes: Optional[int] = None
    causal_attn: Optional[str] = None
    embedding_type: str = 'baseline'
    position_embedding: str = '1d'
    bottom_head_type: str = 'linear'
    use_random_order: bool = False
    rate_random_order: float = 1.0


@dataclass
class Stage2Config:
    type: str = 'transformer1d'
    vocab_size_txt: int = 16384
    vocab_size_img: int = 16384
    vocab_sizes_img: List[int] = field(default_factory=lambda: [8192, 8192, 8192])
    decoding_type: Optional[str] = None
    ratio_bot2top: int = 4
    use_pretrained: bool = False
    use_cls_cond: Optional[bool] = None
    use_txt_cond: Optional[bool] = None
    weight_bottom: Optional[float] = 4.0
    weight_txt: Optional[float] = None
    weight_img: Optional[float] = None
    gamma_focal_loss: Optional[float] = None
    temp_soft_labels: Optional[float] = None
    use_l2norm_logits: Optional[bool] = None
    hparams: Optional[Stage2Hparams] = None
    hparams_enc: Optional[Stage2Hparams] = None
    hparams_dec: Optional[Stage2Hparams] = None


@dataclass
class WarmupConfig:
    warmup_epoch: float = 1.0
    multiplier: float = 1.0
    buffer_epoch: float = 0.0
    min_lr: float = 0.0
    mode: str = 'fix'
    peak_lr: float = 1e-4
    start_from_zero: bool = True


@dataclass
class OptConfig:
    opt_type: str = 'adam'
    base_lr: float = 1e-4
    weight_decay: float = 1e-4
    betas: List[float] = field(default_factory=lambda: [0.9, 0.99])
    grad_clip_norm: Optional[float] = 1.0
    use_amp: bool = True
    sched_type: str = 'cosine'
    max_steps: Optional[int] = None
    steps_per_epoch: Optional[int] = None
    min_lr: float = 0.0
    init_lr: float = 0.0
    warmup: Optional[WarmupConfig] = None
    warmup_config: WarmupConfig = field(default_factory=WarmupConfig)


@dataclass
class ExpConfig:
    local_batch_size: int = 16
    total_batch_size: int = 512
    valid_batch_size: int = 32
    epochs: int = 100
    save_ckpt_freq: int = 2
    test_freq: int = 1
    img_logging_freq: int = 5000
    fp16_grad_comp: bool = False
    use_amp: bool = True


@dataclass
class Stage1TrainConfig:
    """Stage-1 config: the schema of the stage-1 YAMLs."""
    dataset: DataConfig = field(default_factory=DataConfig)
    stage1: Stage1Config = field(default_factory=Stage1Config)
    optimizer: OptConfig = field(default_factory=OptConfig)
    experiment: ExpConfig = field(default_factory=ExpConfig)


@dataclass
class TwoStageConfig:
    """Full two-stage model config."""
    dataset: DataConfig = field(default_factory=DataConfig)
    stage1: Stage1Config = field(default_factory=Stage1Config)
    stage2: Stage2Config = field(default_factory=Stage2Config)
    optimizer: OptConfig = field(default_factory=OptConfig)
    experiment: ExpConfig = field(default_factory=ExpConfig)


# ---------------------------------------------------------------------------
# YAML loading / merging
# ---------------------------------------------------------------------------

_OPTIONAL_SCHEMAS = {
    'Stage1Hparams': Stage1Hparams,
    'Stage1HparamsDisc': Stage1HparamsDisc,
    'VQGAN2Hparams': VQGAN2Hparams,
    'Stage2Hparams': Stage2Hparams,
    'WarmupConfig': WarmupConfig,
    'OptConfig': OptConfig,
}


def _instantiate_optional(ftype: Any):
    """Instantiate the dataclass named inside an Optional[...] annotation."""
    name = str(ftype)
    for schema_name, cls in _OPTIONAL_SCHEMAS.items():
        if schema_name in name:
            return cls()
    raise TypeError(f'cannot instantiate optional config of type {ftype}')


def _merge_into_dataclass(obj: Any, data: Optional[dict]) -> Any:
    """Overlay a (possibly partial) dict onto a dataclass instance: unknown
    keys are rejected, None sub-configs are instantiated from their schema
    before merging (OmegaConf.merge semantics)."""
    if data is None:
        return obj
    fields = {f.name: f for f in dataclasses.fields(obj)}
    for key, value in data.items():
        if key not in fields:
            raise KeyError(f"unknown config key '{key}' for {type(obj).__name__}")
        current = getattr(obj, key)
        if isinstance(value, dict):
            if current is None:
                current = _instantiate_optional(fields[key].type)
                setattr(obj, key, current)
            if dataclasses.is_dataclass(current):
                _merge_into_dataclass(current, value)
            else:
                setattr(obj, key, value)
        else:
            setattr(obj, key, value)
    return obj


class _YamlLoader(yaml.SafeLoader):
    """SafeLoader that also resolves '4e-5'-style floats (no dot before the
    exponent) as floats, as YAML 1.2 and OmegaConf do."""


_YamlLoader.add_implicit_resolver(
    'tag:yaml.org,2002:float',
    re.compile(r'''^(?:
        [-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
       |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
       |\.[0-9_]+(?:[eE][-+][0-9]+)?
       |[-+]?\.(?:inf|Inf|INF)
       |\.(?:nan|NaN|NAN))$''', re.X),
    list('-+0123456789.'))


def load_yaml(path: str) -> dict:
    with open(path, 'r') as fp:
        return yaml.load(fp, Loader=_YamlLoader)


def build_stage1_config(config_path: str) -> Stage1TrainConfig:
    """Stage-1 config: schema defaults overlaid with the YAML. Multi-level
    stage-1 types get the aux schema before the merge; a two-stage YAML's
    `stage2` section is ignored."""
    cfg = Stage1TrainConfig()
    cfg.stage1.hparams_disc = Stage1HparamsDisc()
    data = load_yaml(config_path)
    s1_type = (data.get('stage1') or {}).get('type', cfg.stage1.type)
    if s1_type in ('vqgan2', 'simrqgan2', 'hqvae', 'sivae'):
        cfg.stage1.hparams_aux = VQGAN2Hparams()
    elif s1_type != 'vqgan':
        raise ValueError(f'{s1_type} not supported..')
    _merge_into_dataclass(cfg, {k: v for k, v in data.items()
                                if k != 'stage2'})
    return cfg


def build_twostage_config(config_path: str) -> TwoStageConfig:
    """Two-stage model config: schema defaults overlaid with the YAML."""
    cfg = TwoStageConfig()
    cfg.stage1.hparams_aux = VQGAN2Hparams()
    cfg.stage2.hparams = Stage2Hparams()
    data = load_yaml(config_path)
    # combined train+sample YAMLs may carry stage-1 GAN hparams
    if 'hparams_disc' in (data.get('stage1') or {}):
        cfg.stage1.hparams_disc = Stage1HparamsDisc()
    _merge_into_dataclass(cfg, data)
    return cfg


def save_config(cfg: Any, path: str) -> None:
    """Write the dataclass config `cfg` to `path` as YAML, every field
    included, as the JAX package's `save_config` does;
    `build_twostage_config` or `build_stage1_config` reads it back to an
    equal config."""
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    with open(path, 'w') as fp:
        yaml.safe_dump(dataclasses.asdict(cfg), fp, sort_keys=False)


# ---------------------------------------------------------------------------
# Structured descriptors replacing the reference's string dispatch
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ModelTypeSpec:
    """Parsed `stage2.type` string."""
    family: str          # 'top' | 'bottom' | 'hq-transformer' | 'multilevel-hq'
    depth_mode: str      # 'top2bot' | 'parallel' | 'bidirectional' (2-level only)
    bot_win: int = 1


def parse_model_type(type_str: str) -> ModelTypeSpec:
    if type_str == 'top':
        return ModelTypeSpec('top', 'none')
    if type_str == 'bottom':
        return ModelTypeSpec('bottom', 'none')
    if 'multilevel-hq' in type_str:
        return ModelTypeSpec('multilevel-hq', 'none')
    if 'hq-transformer' in type_str:
        sub = type_str.split('/')[-1] if '/' in type_str else 'top2bot'
        for mode in ('parallel', 'bidirectional'):
            if mode in sub:
                suffix = sub.split(mode)[-1]
                n = int(suffix) if suffix else 4
                return ModelTypeSpec('hq-transformer', mode, int(math.isqrt(n)))
        return ModelTypeSpec('hq-transformer', 'top2bot', 1)
    raise ValueError(f'unknown stage2 type {type_str!r}')


@dataclass(frozen=True)
class EmbeddingTypeSpec:
    """Parsed `hparams.embedding_type`."""
    kind: str            # 'reduce' | 'multiple' | 'transformer' | 'bidirectional'
    n_layers_emb: int = 0  # embedding-transformer blocks: N-1 for 'transformerN'


def parse_embedding_type(s: str) -> EmbeddingTypeSpec:
    for tok in ('transformer', 'bidirectional'):
        if tok in s:
            n = int(s.split(tok)[-1])
            return EmbeddingTypeSpec(tok, max(n - 1, 0))
    if s in ('reduce', 'multiple', 'baseline'):
        return EmbeddingTypeSpec(s)
    raise ValueError(f'unknown embedding_type {s!r}')


@dataclass(frozen=True)
class ResampleSpec:
    """Parsed `hparams_aux.upsample`."""
    kind: str            # 'nearest' | 'pixelshuffle' | 'conv' | 'avgpool'
    window: int = 2


def parse_resample(s: Optional[str]) -> ResampleSpec:
    if s is None:
        return ResampleSpec('avgpool', 2)
    for tok in ('nearest', 'pixelshuffle', 'conv'):
        if tok in s:
            suffix = s.split(tok)[-1]
            return ResampleSpec(tok, int(suffix) if suffix else 2)
    raise ValueError(f'{s} is not a supported upsample mode')
