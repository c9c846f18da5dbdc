"""Training runtime.  So far only the restore side of checkpoints (what
serving needs); the optimizer, train step and saving come with the
training slice."""
