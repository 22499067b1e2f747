"""Kernel stages of the decode path, each with its plain torch
version."""
