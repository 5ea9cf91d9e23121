"""python -m geoestimation_tpu_torch.serve --checkpoint DIR [--cpu]"""

from .server import main

if __name__ == "__main__":
    main()
