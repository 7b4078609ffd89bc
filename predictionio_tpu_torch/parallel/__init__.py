"""Device layout helpers of the port (row sharding over a device list)."""
