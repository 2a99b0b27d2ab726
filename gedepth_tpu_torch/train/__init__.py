"""Training of the port: losses and optimizer recipe, the train step, the
iteration loop with evaluation and checkpoints, and the checkpoint formats
(the counterparts of `gedepth_tpu.train`)."""
