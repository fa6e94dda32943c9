"""The plain reference the benchmark holds the program against: torch and
NumPy only, nothing of the program."""
