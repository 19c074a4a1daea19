"""``python -m neural_enhanced_super_resolution_torch`` entry point."""

import sys

from neural_enhanced_super_resolution_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
