"""Data pipeline of the port: the synthetic corpus and OS4M-scheduled
sequence packing (numpy copies of the reference's ``repro.data``)."""
