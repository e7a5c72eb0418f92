"""The plain reference: float32 PyTorch, no import of the program."""
