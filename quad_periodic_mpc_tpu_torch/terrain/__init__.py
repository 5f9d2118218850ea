"""Terrain tier: per-cell Kalman elevation mapping + map-aware foothold
selection (counterpart of ``quad_periodic_mpc_tpu/terrain``)."""
