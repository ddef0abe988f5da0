"""The worker's side of the port: its process-group join and setup."""
