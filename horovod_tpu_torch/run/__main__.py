"""``python -m horovod_tpu_torch.run``: the ``tpurun-torch`` launcher."""

from horovod_tpu_torch.run.run import main

if __name__ == "__main__":
    main()
