"""Process start to the window's first synchronised reading: importing
torch, the CUDA context, the kernel library's load (its build on the
first run of a checkout), the boards, the program's start and the
warm-up."""


def read(seen):
    return seen.setup_s if seen.setup_s > 0 else None
