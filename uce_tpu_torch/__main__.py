import sys

from uce_tpu_torch.cli.main import main

sys.exit(main())
