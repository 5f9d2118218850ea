"""Host runtime: the native bindings (counterpart of
``quad_periodic_mpc_tpu/runtime``): the C++ periodic loop, shared-memory
ring, UDP robot bridge and safety filter, the rebuild of the reference's
LoopFunc / SharedMemory / unitree UDP tier; and ``graphs``, the CUDA
graphs that replay a captured period or tick (the counterpart of the
reference's jitted programs)."""
