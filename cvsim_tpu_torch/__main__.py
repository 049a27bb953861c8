import sys

# `-via` dispatches before cvsim_tpu_torch.cli.main is imported: the thin
# client needs only the standard library (cli/serve.py run_via), so
# `python -S -m cvsim_tpu_torch -via <socket> ...` works and starts without
# importing numpy or torch. Everything else goes through the full CLI.
if len(sys.argv) >= 3 and sys.argv[1] == "-via":
    from cvsim_tpu_torch.cli.serve import run_via

    raise SystemExit(run_via(sys.argv[2], sys.argv[3:]))

from cvsim_tpu_torch.cli.main import main  # noqa: E402

if __name__ == "__main__":
    raise SystemExit(main())
