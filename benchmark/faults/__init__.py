"""Faults planted in the port underneath one entry point, one file an entry:
``altered(monkeypatch)`` and ``half_batch(monkeypatch)``. The CPU tests plant
each and see the cell's check come out not correct."""
