"""Training of the port: AdamW, the train state, the epoch and validation loops."""
