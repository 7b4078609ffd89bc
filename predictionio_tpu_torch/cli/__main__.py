import sys

from predictionio_tpu_torch.cli.main import main

sys.exit(main())
