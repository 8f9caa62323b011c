"""Launchers (the serving one in this slice)."""
