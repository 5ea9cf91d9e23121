"""Measurement tools of the port: the kernel and stage benches and the seeded
world they share. They run on a CUDA card only."""
