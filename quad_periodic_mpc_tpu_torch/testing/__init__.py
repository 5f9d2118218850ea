"""Seeded inputs shared by the card tests and chip_smoke.py."""
