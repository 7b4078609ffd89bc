"""Entity id maps and rating columns."""
