import sys

from tpusvm_torch.cli import main

sys.exit(main())
