"""Share of the traced window in which nothing ran on the card: one
minus the union of kernel, copy and memset intervals in the
`torch.profiler` trace over the window's length."""


def read(seen):
    return seen.idle_pct()
