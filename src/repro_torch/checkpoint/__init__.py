"""Atomic, async checkpoints that restore across the two packages."""
