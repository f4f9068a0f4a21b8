import sys

from tpulab_torch.cli.main import main

sys.exit(main())
