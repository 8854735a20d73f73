"""Slurm allocation provisioner (parity: sky/provision for slurm)."""
