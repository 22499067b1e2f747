"""``python -m meterelf_tpu_torch`` runner (reference: meterelf/__main__.py)."""
from .cli import main

if __name__ == "__main__":
    main()
