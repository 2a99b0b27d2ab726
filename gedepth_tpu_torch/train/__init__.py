"""Training of the port: losses and optimizer recipe, the train step and the
iteration loop (the counterparts of `gedepth_tpu.train`)."""
