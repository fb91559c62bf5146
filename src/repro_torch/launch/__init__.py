"""Serving: the continuous-batching engine and its command-line entry point."""
