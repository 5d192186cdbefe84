"""Adapters around the port's entry points, one file a traffic mix's ``entry``."""
