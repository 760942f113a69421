"""Serving entry points of the port: the request API and the engine."""
