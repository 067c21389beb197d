"""The plain reference: built from the schemes' coefficients alone, it
imports nothing of the program."""
