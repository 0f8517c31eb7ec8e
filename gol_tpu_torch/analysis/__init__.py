"""Analysis helpers of the port (see `concurrency.lockcheck`)."""
