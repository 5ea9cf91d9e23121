"""Training shards and batches, and eval image folders."""
