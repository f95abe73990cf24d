"""Problem IO: fixture generators (counterpart of :mod:`pycllp_tpu.io`)."""
