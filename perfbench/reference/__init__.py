"""Plain references of the semantics each cell's configuration states;
see `life.py`."""
