"""Repo maintenance: commit-everything updates and dated source pickups.

Re-expression of the reference's maintenance scripts (git-update-all,
git-update-all-wo-push, git-source-pickup.pl) as a library +
`repo-*` subcommands; the port's copy of cvsim_tpu/utils/repo_maint.py:

- update_all:    clean build artifacts, stage the whole tree, commit,
                 then (optionally) push the current branch and fetch
                 (git-update-all:1-18; the -wo-push variant stops after
                 the commit).
- source_pickup: ensure the tree is committed, then pack the project
                 directory (``tar -C .. <project>``, .git included) into
                 ``../{name}-{YYYYMMDD-HHMMSS}-commit-{hash}-src
                 [-branch-{branch}].tar`` and compress with ``xz -6e``,
                 skipping if the .xz already exists
                 (git-source-pickup.pl:5-71).

Pure host tooling: no torch, no device. Date stamps come from the LAST
COMMIT (author date), not wall clock, so repeated pickups of the same
commit are no-ops — that is the reference's dedup semantics.
"""

from __future__ import annotations

import os
import subprocess


def _git(repo: str, *args: str, check: bool = True) -> str:
    r = subprocess.run(["git", "-C", repo, *args],
                       capture_output=True, text=True)
    if check and r.returncode != 0:
        raise RuntimeError(
            f"git {' '.join(args)} failed (rc={r.returncode}): "
            f"{r.stderr.strip()[-500:]}")
    return r.stdout


def current_branch(repo: str) -> str:
    """The checked-out branch name; raises when detached/unborn (the
    reference scripts exit 1 on an empty branch: git-update-all:5-8)."""
    name = _git(repo, "branch", "--show-current").strip()
    if not name:
        raise RuntimeError("unable to determine current branch")
    return name


def _clean_build_tree(repo: str) -> None:
    """make clean / make distclean / ./cleantree, all best-effort
    (git-update-all:10-12)."""
    devnull = subprocess.DEVNULL
    if os.path.exists(os.path.join(repo, "Makefile")):
        for target in ("clean", "distclean"):
            subprocess.run(["make", target], cwd=repo, stdout=devnull,
                           stderr=devnull)
    cleantree = os.path.join(repo, "cleantree")
    if os.access(cleantree, os.X_OK):
        subprocess.run([cleantree], cwd=repo, stdout=devnull,
                       stderr=devnull)


def update_all(repo: str, message: str | None = None,
               push: bool = True) -> str:
    """Commit the whole working tree; optionally push + fetch.

    Returns the branch name. An up-to-date tree is not an error (the
    reference pipes `git commit -a` through an interactive editor and
    shrugs off the failure; non-interactively we only commit when
    something is staged)."""
    branch = current_branch(repo)
    _clean_build_tree(repo)
    _git(repo, "add", "-A")
    staged = _git(repo, "status", "--porcelain").strip()
    if staged:
        _git(repo, "commit", "-a", "-m",
             message or "repo-update-all: commit working tree")
    if push:
        _git(repo, "push", "origin", branch)
        _git(repo, "fetch")
    return branch


def source_pickup(repo: str, as_name: str | None = None,
                  out_dir: str | None = None,
                  commit_first: bool = True) -> str | None:
    """Pack the project directory into a dated, commit-stamped .tar.xz
    next to it (or into out_dir) and return the archive path.

    Naming matches git-source-pickup.pl:60:
    ``{name}-{YYYYMMDD}-{HHMMSS}-commit-{hash}-src[-branch-{b}].tar.xz``
    with the timestamp taken from the last commit's author date. Returns
    None when the archive already exists (the reference skips:
    git-source-pickup.pl:61)."""
    repo = os.path.abspath(repo)
    branch = current_branch(repo)
    if commit_first:
        # "Ensuring the build tree is clean..." (git-source-pickup.pl:9-11
        # runs git-update-all-wo-push)
        update_all(repo, push=False)
    out = _git(repo, "log", "--max-count=1",
               "--format=%H%n%ad", "--date=format:%Y%m%d-%H%M%S")
    lcommit, lcdate = (out.strip().splitlines() + ["unknown"])[:2]
    lcommit = lcommit.lower()
    project = os.path.basename(repo)
    parent = os.path.dirname(repo)
    out_dir = os.path.abspath(out_dir) if out_dir else parent
    branch_sfx = f"-branch-{branch}" if branch else ""
    name = as_name or project
    tarball = os.path.join(
        out_dir, f"{name}-{lcdate}-commit-{lcommit}-src{branch_sfx}.tar")
    if os.path.exists(tarball + ".xz"):
        return None
    # tar the project DIRECTORY from its parent (.git included — the
    # reference's --exclude=.git is commented out: git-source-pickup.pl:65)
    r = subprocess.run(["tar", "-C", parent, "-cf", tarball, project],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"tar failed: {r.stderr.strip()[-500:]}")
    r = subprocess.run(["xz", "-6e", tarball], capture_output=True,
                       text=True)
    if r.returncode != 0:
        raise RuntimeError(f"xz failed: {r.stderr.strip()[-500:]}")
    return tarball + ".xz"


def main_update_all(argv) -> int:
    """CLI: cvsim repo-update-all [-no-push] [-m msg] [-C repo]"""
    repo, push, msg = ".", True, None
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-no-push":
            push = False
        elif a == "-m" and i + 1 < len(argv):
            i += 1
            msg = argv[i]
        elif a == "-C" and i + 1 < len(argv):
            i += 1
            repo = argv[i]
        else:
            print(f"repo-update-all: unknown arg {a!r}")
            return 1
        i += 1
    branch = update_all(repo, message=msg, push=push)
    print(f"updated branch {branch}" + ("" if push else " (no push)"))
    return 0


def main_source_pickup(argv) -> int:
    """CLI: cvsim repo-source-pickup [-as name] [-o outdir] [-C repo]"""
    repo, as_name, out_dir = ".", None, None
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-as" and i + 1 < len(argv):
            i += 1
            as_name = argv[i]
        elif a == "-o" and i + 1 < len(argv):
            i += 1
            out_dir = argv[i]
        elif a == "-C" and i + 1 < len(argv):
            i += 1
            repo = argv[i]
        else:
            print(f"repo-source-pickup: unknown arg {a!r}")
            return 1
        i += 1
    path = source_pickup(repo, as_name=as_name, out_dir=out_dir)
    print(f"packed: {path}" if path else "archive already exists, skipping")
    return 0
