import sys

from distributed_tpu_torch.analysis.cli import main

# guarded, unlike the reference's, so that importing the module (as the
# port's import check does with every module) runs no lint
if __name__ == "__main__":
    sys.exit(main())
