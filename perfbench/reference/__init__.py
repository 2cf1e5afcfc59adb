"""Plain references the program's outputs are judged by (no program code)."""
