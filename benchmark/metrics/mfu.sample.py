"""The whole call's share of the card's bf16 peak: the model FLOPs of a
sample (the reference's stage-2 forward and stage-1 decode, counted on
shapes: `counts.stage2_forward_flops`, `decode_flops`) times the samples
of the traced run's unprofiled window calls, over their host-clock time
and over 989 TFLOP/s."""

from hqbench import counts


def read(out):
    if 'flops_per_unit' not in out.info:
        return None
    calls = [(s, u) for s, u, profiled in out.info['calls'] if not profiled]
    if not calls:
        return None
    seconds = sum(s for s, _ in calls)
    units = sum(u for _, u in calls)
    return 100.0 * out.info['flops_per_unit'] * units / seconds / \
        counts.BF16_FLOPS_PER_S
