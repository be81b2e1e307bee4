"""`python -m vid2player3d_torch --cfg <name> [...]`: see `cli.run`."""

from vid2player3d_torch.cli.run import main

if __name__ == "__main__":
    raise SystemExit(main())
