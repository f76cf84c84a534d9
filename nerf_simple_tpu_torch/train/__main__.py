"""python -m nerf_simple_tpu_torch.train --config_path configs/lego.yaml"""

from nerf_simple_tpu_torch.train.loop import main

if __name__ == "__main__":
    main()
