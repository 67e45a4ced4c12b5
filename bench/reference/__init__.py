"""The plain reference that decides ``correct``: imports nothing of the
program."""
