"""Train and eval steps (one device; DDP is not ported yet)."""
