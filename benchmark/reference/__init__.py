"""Plain references of the configurations' systems: torch and numpy only,
nothing of the port."""
