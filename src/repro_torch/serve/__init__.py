"""Serving: the continuous-batching engine with OS4M lane scheduling."""
