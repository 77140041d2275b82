"""The plain reference of the stream path (imports nothing of the
program)."""
