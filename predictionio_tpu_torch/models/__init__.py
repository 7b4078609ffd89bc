"""Engine templates (serving side)."""
