"""Host-side data of the port: samplers and the prefetching feed (numpy)."""
