"""Stage-1 training: losses, optimizer, step, loop, checkpoints."""
