"""Models of the port (``nn.Module``s) and the Flax weights bridge."""
