"""Multi-process training: the process grid, data, tensor, sequence and
pipeline parallelism, ZeRO-1, and the train and eval steps."""
