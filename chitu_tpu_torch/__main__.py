"""`python -m chitu_tpu_torch key=value ...` launches the server
(reference: chitu/__main__.py:1-5)."""

from chitu_tpu_torch.serve import main

main()
