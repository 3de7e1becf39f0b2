"""Step functions of the port (serving so far; training comes with the
trainer slice)."""
