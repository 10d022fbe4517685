import sys

from analytics_zoo_tpu_torch.analysis.cli import main

if __name__ == "__main__":
    try:
        rc = main()
        sys.stdout.flush()
    except BrokenPipeError:
        # reader went away (e.g. `... | head`) — not a lint failure
        rc = 0
    sys.exit(rc)
