"""Training of the port: the production loss, the optimizer and the train step."""
