"""Training CLI (counterpart of ofasys_tpu/cli/train.py): two ways to
configure a run, one build path --

  file:   python -m ofasys_torch.cli.train cfg.yaml|cfg.json [--set a.b=v] [--device cpu]
  flags:  python -m ofasys_torch.cli.train --ofasys.task=caption \\
              --ofasys.task.caption.dataset.train_data=data.tsv \\
              --ofasys.model.arch=base --ofasys.optimization.lr=[1.0e-4]
"""

import sys


def main(argv):
    from ofasys_torch.parallel.distributed import distributed_init

    distributed_init()
    if any(a.startswith("--ofasys.") for a in argv):
        from ofasys_torch.configure.options import parse_args_and_build

        device = None
        if "--device" in argv:
            i = argv.index("--device")
            device, argv = argv[i + 1], argv[:i] + argv[i + 2:]
        trainer, model, tasks = parse_args_and_build(argv, device)
        trainer.fit(model, tasks)
        return 0
    from ofasys_torch.launch import main as launch_main

    return launch_main(argv)


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
