"""Package a model (config + checkpoint) into a self-contained serving
directory, counterpart of tools/deployment/package_model.py (the
reference's TorchServe archiver, mmdet2torchserve.py: config + serialized
file + handler manifest -> `{model_name}.mar`):

    python -m mcgaze_tpu_torch.tools.deployment.package_model <config>
        <ckpt.pth> --output-folder DIR [--model-name N] [--archive] [-f]

The package is a plain directory (`{output_folder}/{model_name}/`) holding
the config, the .pth checkpoint (and its `_train.pth` split, which
`serve --ema` reads, when there is one) and MANIFEST.json;
`tools.deployment.serve <package_dir>` serves it with no other arguments.
`--archive` also tars the directory to `{model_name}.mar`.
"""
from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import shutil
import tarfile
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('config', help='config file path')
    p.add_argument('checkpoint', help='torch .pth')
    p.add_argument('--output-folder', required=True)
    p.add_argument('--model-name', default=None,
                   help='default: checkpoint basename')
    p.add_argument('--model-version', default='1.0')
    p.add_argument('--archive', action='store_true',
                   help='also write {model_name}.mar (tar of the dir)')
    p.add_argument('-f', '--force', action='store_true',
                   help='overwrite an existing package')
    return p.parse_args(argv)


def package_model(config: str, checkpoint: str, output_folder: str,
                  model_name: str = None, model_version: str = '1.0',
                  force: bool = False, archive: bool = False) -> str:
    from ...utils.checkpoint import require_pth, train_path

    require_pth(checkpoint)
    name = model_name or osp.splitext(osp.basename(checkpoint))[0]
    pkg = osp.join(output_folder, name)
    if osp.exists(pkg):
        if not force:
            raise SystemExit(f'{pkg} exists (use --force to overwrite)')
        shutil.rmtree(pkg)
    os.makedirs(pkg)

    cfg_name = 'config' + osp.splitext(config)[1]
    shutil.copy(config, osp.join(pkg, cfg_name))
    ckpt_name = osp.basename(checkpoint)
    shutil.copy(checkpoint, osp.join(pkg, ckpt_name))
    # the resume/EMA split, where there is one: serving --ema reads it
    if osp.isfile(train_path(checkpoint)):
        shutil.copy(train_path(checkpoint),
                    train_path(osp.join(pkg, ckpt_name)))

    manifest = dict(model_name=name, version=model_version,
                    config=cfg_name, checkpoint=ckpt_name,
                    runtime='torch-cuda',
                    created=time.strftime('%Y-%m-%dT%H:%M:%SZ',
                                          time.gmtime()))
    with open(osp.join(pkg, 'MANIFEST.json'), 'w') as f:
        json.dump(manifest, f, indent=2)

    if archive:
        mar = osp.join(output_folder, f'{name}.mar')
        with tarfile.open(mar, 'w') as tar:
            tar.add(pkg, arcname=name)
        print(f'archived {mar}')
    print(f'packaged {pkg}')
    return pkg


def main(argv=None) -> str:
    args = parse_args(argv)
    return package_model(args.config, args.checkpoint, args.output_folder,
                         args.model_name, args.model_version, args.force,
                         args.archive)


if __name__ == '__main__':
    main()
