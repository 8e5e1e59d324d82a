import sys

from rmi_tpu_torch.cli import main

sys.exit(main())
