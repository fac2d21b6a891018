"""Plain PyTorch references of what the timed path computes; they import
nothing of the program."""
