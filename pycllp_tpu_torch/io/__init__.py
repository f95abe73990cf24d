"""Problem IO: the MPS reader/writer, the netlib fixtures and the random
fixture generators (counterpart of :mod:`pycllp_tpu.io`)."""
