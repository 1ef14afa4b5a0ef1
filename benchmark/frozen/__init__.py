"""Frozen copies of program code that the benchmark's inputs depend on, so
that no change to the program can change the yardstick's input."""
