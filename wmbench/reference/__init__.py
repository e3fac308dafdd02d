"""The plain reference the check compares the program with: float32, TF32
off, plain torch operations; it imports nothing of the program."""
