"""Entity id maps."""
