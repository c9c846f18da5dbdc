"""EDF columnar storage: the port's reader and writer."""
