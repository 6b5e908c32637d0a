"""The general machinery of the benchmark."""
