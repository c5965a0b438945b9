"""COMET reasoning generation over the prepared SBU index:
``python -m kmbart_tpu_torch.scripts.prepare_sbu_reason``.

Twin of scripts/prepare_sbu_reason.py: ``reason_common.run`` over the
SBU captions.
"""

from kmbart_tpu_torch.scripts.reason_common import run


def main(argv=None):
    run(caption_key="labels", annot_help="directory with the prepared sbu {split}.json files",
        argv=argv)


if __name__ == "__main__":
    main()
