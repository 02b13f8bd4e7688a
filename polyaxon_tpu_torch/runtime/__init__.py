"""The port's runtime: the optimizer and the single-device train step."""
