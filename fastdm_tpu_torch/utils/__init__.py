"""Logging, profiling and the PNG codec of the port's front-ends."""
