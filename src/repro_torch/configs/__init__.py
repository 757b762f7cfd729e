"""Model configurations: the paper's networks."""
