"""The plain reference that decides a run's ``correct``; it imports nothing of the program."""
