"""The benchmark's own code: cell resolution, building and feeding the
engine, the timed window, the traced run's reader, the comparison that
decides `correct`, and the roofline arithmetic.  Nothing here imports the
JAX package or JAX."""
