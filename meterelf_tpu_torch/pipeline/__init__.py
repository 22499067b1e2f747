"""The batched decode path."""
