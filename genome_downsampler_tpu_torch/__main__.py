import sys

from genome_downsampler_tpu_torch.cli.main import main

sys.exit(main())
