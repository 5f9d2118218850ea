"""Test and parity support: seeded kernel inputs shared by the card tests
and chip_smoke.py, the MPC-QP fixtures and the golden qpOASES solves."""
