"""Tools of the port: the kernel and stage benches and the seeded world they
share, which run on a CUDA card only, and the import of a reference Lightning
checkpoint (`import_torch_checkpoint`), which runs on the CPU."""
