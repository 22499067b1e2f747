"""Host input of the port: the JPEG coefficient feed (``jpeg.py``)."""
