"""Small shared utilities: parameter-tree helpers, draws, devices, logging."""
