"""Device kernels and their host helpers."""
