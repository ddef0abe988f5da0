"""Device operations of the port: the leveled placement engine and flash attention."""
