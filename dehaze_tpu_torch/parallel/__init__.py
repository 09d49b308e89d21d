"""Several processes, one per GPU: the process group and the halo exchange."""
