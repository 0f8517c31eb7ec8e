"""Cell updates the card completed in the window, over the window's
length, in Gcells/s (cells x turns; the window's edges are
device-synchronised readings)."""


def read(seen):
    return seen.gcells_per_s()
