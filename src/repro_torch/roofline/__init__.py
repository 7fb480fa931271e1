"""Closed-form predictions of the port (the stash's bytes so far)."""
