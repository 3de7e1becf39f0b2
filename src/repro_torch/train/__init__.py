"""Step functions and the training loop of the port."""
