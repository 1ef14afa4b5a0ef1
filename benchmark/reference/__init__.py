"""The plain float32 reference, which imports nothing of the program."""
