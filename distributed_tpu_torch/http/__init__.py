"""The port's pieces of the HTTP endpoints."""
