"""The port's trainer: AdamW, the train step, checkpoints and the
fault-tolerant loop (the port of ``repro.train``)."""
