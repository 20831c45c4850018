"""Re-path audio references in JSONL annotation files after moving/splitting
a dataset (reference: tools/audio_process/annotation_update.py).

Counterpart of `tools/audio_process/annotation_update.py`, with its flags:

    python -m tpu_speech_commands_torch.audio_process.annotation_update --help
"""
import argparse
import json


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--annotation_file", required=True, help="input JSONL")
    parser.add_argument("--output_file", required=True)
    parser.add_argument("--old_prefix", required=True)
    parser.add_argument("--new_prefix", required=True)
    parser.add_argument("--path_key", default="audio_filepath")
    args = parser.parse_args(argv)

    count = 0
    with open(args.annotation_file) as fin, open(args.output_file, "w") as fout:
        for line in fin:
            line = line.strip()
            if not line:
                continue
            record = json.loads(line)
            # anchored prefix rewrite: str.replace would corrupt paths that
            # merely CONTAIN old_prefix mid-path
            if args.path_key in record and record[args.path_key].startswith(
                args.old_prefix
            ):
                record[args.path_key] = (
                    args.new_prefix + record[args.path_key][len(args.old_prefix):]
                )
                count += 1
            fout.write(json.dumps(record) + "\n")
    print(f"updated {count} records -> {args.output_file}")


if __name__ == "__main__":
    main()
