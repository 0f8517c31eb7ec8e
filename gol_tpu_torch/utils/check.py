"""Error escalation + board assertion helpers — the port's copy of
`gol_tpu.utils.check` (ref: util/check.go:3-7, board multiset compare
ref: gol_test.go:58-86)."""

from typing import Iterable


def check(err):
    """Raise if `err` is an exception / truthy error value."""
    if isinstance(err, BaseException):
        raise err
    if err:
        raise RuntimeError(str(err))


def assert_equal_board(got: Iterable, want: Iterable, width: int, height: int):
    """Alive-cell set equality with an ASCII side-by-side diff for small
    boards on failure — the reference's assertEqualBoard + 16x16 diff
    rendering (ref: gol_test.go:49-86, util/visualise.go:21-48)."""
    got_set, want_set = set(got), set(want)
    if got_set == want_set:
        return
    msg = [f"boards differ: {len(got_set)} alive, expected {len(want_set)}"]
    if width <= 64 and height <= 64:
        from gol_tpu_torch.utils.visualise import alive_cells_to_string

        msg.append(alive_cells_to_string(sorted(got_set), sorted(want_set),
                                         width, height))
    else:
        only_got = sorted(got_set - want_set)[:10]
        only_want = sorted(want_set - got_set)[:10]
        msg.append(f"first extra cells: {only_got}")
        msg.append(f"first missing cells: {only_want}")
    raise AssertionError("\n".join(msg))
