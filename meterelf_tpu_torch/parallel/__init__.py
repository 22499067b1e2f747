"""Data parallelism over several devices and processes."""
