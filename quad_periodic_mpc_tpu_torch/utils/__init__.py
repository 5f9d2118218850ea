"""Utilities (counterpart of ``quad_periodic_mpc_tpu/utils``): the signal
filters."""
