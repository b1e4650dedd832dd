"""The plain reference that the output check holds the program to."""
