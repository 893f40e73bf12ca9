"""GiB the op lowering writes a step in tensors it materialises (a stack
that is not a view, the wrap pad's cats, the staggered velocity's roll and
sum, a copying `contiguous`): the program's counter
`repro_torch.core.spans.LOWERING`, bytes over the timesteps its plans
advanced (a k-step round counts k). The totals are the whole process's:
set-up's warm-up and the dispatch-timing runs count beside the measured
window, so the share of rounds that copy less (a forecast's first round
finds its state stacked already) follows the harness's mix a little. None
where the program has no such counter."""


def read(run):
    try:
        from repro_torch.core.spans import LOWERING
    except ImportError:
        return None
    if not LOWERING.get("steps"):
        return None
    return LOWERING["bytes"] / LOWERING["steps"] / 2**30
