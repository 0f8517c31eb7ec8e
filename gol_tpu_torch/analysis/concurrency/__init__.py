"""Concurrency tooling the port needs: the lock factory (`lockcheck`)."""
