"""Plain references: torch and numpy only, in float64; nothing of the port."""
